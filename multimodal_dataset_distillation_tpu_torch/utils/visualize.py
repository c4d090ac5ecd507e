"""Artifacts of the distill eval block (reference distill.py:358-426).

The port's own copy of ``multimodal_dataset_distillation_tpu/utils/
visualize.py``, with the same file names:

* ``synthetic_images_{it}.png``: the first 90 synthetic images, 4x
  nearest-neighbour upsampled, each min-max scaled, 10 per row;
* ``clipped_synthetic_images_{it}_std_2.5.png``: the same after clipping
  at mean +- 2.5 std (distill_original.py:324-336);
* ``synthetic_sentences_{it}.txt``: the cosine-nearest real train caption
  of each synthetic text embedding (distill.py:89-95);
* ``distilled_{it}.npz``: ``image_syn``, ``text_syn`` and the learned
  ``syn_lr_img``/``syn_lr_txt`` (what ``cli/eval_distilled`` reads);
* under ``--save_pt``: ``images_{it}.pt`` (NCHW) and ``labels_{it}.pt``;
* under ``--zca`` (a fitted :class:`~..ops.zca.ZCAWhitening`), the
  de-whitened set (distill.py:407-426): ``zca_synthetic_images_{it}.png``,
  ``clipped_zca_synthetic_images_{it}_std_{cv}.png`` and, with
  ``--save_pt``, ``images_zca_{it}.pt`` (NCHW).
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np
import torch
from PIL import Image


def nearest_neighbor(sentences: Sequence[str], query_embeddings: np.ndarray,
                     all_embeddings: np.ndarray) -> List[str]:
    """Cosine-nearest real sentence per synthetic embedding."""
    q = np.asarray(query_embeddings, np.float64)
    a = np.asarray(all_embeddings, np.float64)
    qn = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    an = a / np.maximum(np.linalg.norm(a, axis=1, keepdims=True), 1e-12)
    idx = np.argmax(qn @ an.T, axis=1)
    return [sentences[i] for i in idx]


def _minmax(img: np.ndarray) -> np.ndarray:
    lo, hi = img.min(), img.max()
    return (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)


def make_grid(images: np.ndarray, nrow: int = 10, upsample: int = 4,
              pad: int = 2) -> np.ndarray:
    """NHWC float images (the first 90) -> a uint8 grid."""
    images = np.asarray(images)[:90]
    if upsample > 1:
        images = images.repeat(upsample, axis=1).repeat(upsample, axis=2)
    n, h, w, c = images.shape
    rows = (n + nrow - 1) // nrow
    grid = np.zeros((rows * (h + pad) + pad, nrow * (w + pad) + pad, c),
                    np.float32)
    for i in range(n):
        r, col = divmod(i, nrow)
        y, x = r * (h + pad) + pad, col * (w + pad) + pad
        grid[y:y + h, x:x + w] = _minmax(images[i])
    return (grid * 255).astype(np.uint8)


def save_visualizations(save_dir: str, it: int, image_syn: np.ndarray,
                        text_syn: np.ndarray, train_sentences: Sequence[str],
                        train_caption_embed: np.ndarray,
                        clip_vals: Sequence[float] = (2.5,),
                        save_grids: bool = True, syn_lrs=None,
                        save_pt: bool = False, zca=None) -> dict:
    """Write the artifacts listed above; -> {kind: path}.

    ``save_grids=False`` is the reference's ``ipc >= 50 and not
    force_save`` gate (distill.py:368): no PNGs and no sentences, the
    distilled-tensor npz all the same."""
    os.makedirs(save_dir, exist_ok=True)
    out = {}
    if save_pt:
        out.update(_save_torch(save_dir, it, image_syn, text_syn, zca))
    if save_grids:
        p = os.path.join(save_dir, f"synthetic_images_{it}.png")
        Image.fromarray(make_grid(image_syn)).save(p)
        out["grid"] = p

        sentences = nearest_neighbor(train_sentences, text_syn,
                                     train_caption_embed)[:90]
        p = os.path.join(save_dir, f"synthetic_sentences_{it}.txt")
        with open(p, "w") as f:
            f.write("\n".join(sentences))
        out["sentences"] = p

        for cv in clip_vals:
            mu, sd = float(np.mean(image_syn)), float(np.std(image_syn))
            clipped = np.clip(image_syn, mu - cv * sd, mu + cv * sd)
            p = os.path.join(save_dir,
                             f"clipped_synthetic_images_{it}_std_{cv}.png")
            Image.fromarray(make_grid(clipped)).save(p)
            out[f"clipped_{cv}"] = p

        if zca is not None:
            recon = zca.inverse_transform(np.asarray(image_syn))
            p = os.path.join(save_dir, f"zca_synthetic_images_{it}.png")
            Image.fromarray(make_grid(recon)).save(p)
            out["zca_grid"] = p
            for cv in clip_vals:
                mu, sd = float(np.mean(recon)), float(np.std(recon))
                clipped = np.clip(recon, mu - cv * sd, mu + cv * sd)
                p = os.path.join(
                    save_dir, f"clipped_zca_synthetic_images_{it}_std_{cv}.png")
                Image.fromarray(make_grid(clipped)).save(p)
                out[f"zca_clipped_{cv}"] = p
    out["tensors"] = _save_tensors(save_dir, it, image_syn, text_syn,
                                   syn_lrs)
    return out


def _save_tensors(save_dir: str, it: int, image_syn, text_syn,
                  syn_lrs=None) -> str:
    """``distilled_{it}.npz``, with the learned inner LRs when given (the
    eval's ``lr_net`` is the learned ``syn_lr_img``, distill.py:312)."""
    p = os.path.join(save_dir, f"distilled_{it}.npz")
    extra = {}
    if syn_lrs is not None:
        extra = {"syn_lr_img": np.asarray(float(syn_lrs[0]), np.float32),
                 "syn_lr_txt": np.asarray(float(syn_lrs[1]), np.float32)}
    np.savez(p, image_syn=image_syn, text_syn=text_syn, **extra)
    return p


def _nchw(images) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(images, np.float32).transpose(0, 3, 1, 2)))


def _save_torch(save_dir: str, it: int, image_syn, text_syn,
                zca=None) -> dict:
    """The reference's ``images_{it}.pt`` (NCHW float32) and
    ``labels_{it}.pt`` saves (distill_original.py:292-296), and with a ZCA
    the de-whitened ``images_zca_{it}.pt`` (distill.py:407-410)."""
    out = {"images_pt": os.path.join(save_dir, f"images_{it}.pt"),
           "labels_pt": os.path.join(save_dir, f"labels_{it}.pt")}
    torch.save(_nchw(image_syn), out["images_pt"])
    torch.save(torch.from_numpy(np.array(text_syn, np.float32)),
               out["labels_pt"])
    if zca is not None:
        out["images_zca_pt"] = os.path.join(save_dir, f"images_zca_{it}.pt")
        torch.save(_nchw(zca.inverse_transform(np.asarray(image_syn))),
                   out["images_zca_pt"])
    return out
