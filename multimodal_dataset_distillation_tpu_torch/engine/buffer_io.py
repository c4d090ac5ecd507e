"""Expert-trajectory buffers: read and write.

Counterpart of ``multimodal_dataset_distillation_tpu/engine/buffer_io.py``
(``:37-206, 208-233`` there).  A snapshot is the list of a tower's
per-parameter arrays in ``module.parameters()`` order and torch layouts
(what ``BiEncoderTrainer.snapshot_*_params`` returns); a trajectory is a
list of snapshots.  Two formats:

* ``.npz``: the stacked flat trajectory ``(epochs+1, P)`` in the JAX
  package's ravel order, remapped here to the module's flat order
  (:func:`~..models.convert.flat_from_jax`).
* ``.pt``: the reference container, a list of trajectories of snapshots of
  per-parameter tensors in ``module.parameters()`` order and torch
  layouts: this package's flat order, so snapshots concatenate as stored.
  The JAX package writes a tree it has no reference order for (a BERT
  tower's, ``--text_trainable``; the CLIP ViT-B/32 and ConvNeXt image
  towers, JAX ``models/torch_order.py:421-430``) as the JAX tree's leaves
  instead, in its ravel order and flax shapes.  A snapshot's shape
  signature is checked against both orders of the module (the JAX order
  first for those towers), so a file in another order is refused instead
  of read permuted.  Shapes are compared with ``()`` and ``(1,)`` taken as
  one, as the JAX package's ``identify`` compares them: its writers before
  round 4 passed each leaf through ``ascontiguousarray``, which promotes a
  0-d leaf (a skipinit gain) to ``(1,)``.

Writing keeps each format's order, so the JAX ``load_buffer`` reads what
this module writes: ``.npz`` in JAX ravel order (:func:`~..models.convert.
flat_to_jax`), ``.pt`` in registration order for the image tower and the
projection head (the reference order the JAX package's codec identifies)
and as the JAX tree's leaves for the towers without one, as the JAX
``save_expert`` writes them.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..models.bert import BertEncoder
from ..models.clip_vision import ClipVisionTransformer
from ..models.convert import flat_from_jax, flat_to_jax, jax_leaves, jax_shapes
from ..models.convnext import ConvNeXt

#: towers the JAX package has no reference (torch) order for
_NO_REFERENCE_ORDER = (BertEncoder, ClipVisionTransformer, ConvNeXt)


def has_reference_order(template: nn.Module) -> bool:
    """False for a tower whose ``.pt`` snapshots the JAX package writes as
    its own tree's leaves (BERT, CLIP ViT-B/32, ConvNeXt)."""
    return not isinstance(getattr(template, "model", template),
                          _NO_REFERENCE_ORDER)


def flatten_snapshot(snapshot: Sequence) -> np.ndarray:
    """Snapshot -> flat float32 vector in this package's order."""
    return np.concatenate([np.asarray(x, np.float32).reshape(-1)
                           for x in snapshot])


def stack_trajectory(trajectory: Sequence[Sequence]) -> np.ndarray:
    """List of snapshots -> (epochs+1, P) float32."""
    return np.stack([flatten_snapshot(s) for s in trajectory])


def save_trajectory_npz(path: str, trajectory: Sequence[Sequence],
                        template: nn.Module) -> None:
    """The stacked trajectory in the JAX package's ravel order."""
    np.savez(path, trajectory=flat_to_jax(stack_trajectory(trajectory),
                                          template))


def save_trajectories_pt(path: str,
                         trajectories: Sequence[Sequence[Sequence]]) -> None:
    """``torch.save`` of a list of trajectories of per-parameter tensors, as
    given (the reference container, buffer.py:104-115)."""
    # np.array, not ascontiguousarray: the latter promotes 0-d parameters
    # (skipinit gains) to (1,) and breaks the shape signature readers check
    torch.save([[[torch.from_numpy(np.array(x, copy=True)) for x in snap]
                 for snap in traj] for traj in trajectories], path)


def next_free_index(save_dir: str) -> int:
    """First ``n`` with neither ``img_replay_buffer_{n}.pt`` nor ``.npz``
    present (buffer.py:106-108)."""
    n = 0
    while any(os.path.exists(os.path.join(
            save_dir, f"img_replay_buffer_{n}{ext}")) for ext in (".pt", ".npz")):
        n += 1
    return n


def save_expert(save_dir: str, img_trajectory: Sequence[Sequence],
                txt_trajectory: Sequence[Sequence], img_template: nn.Module,
                txt_template: nn.Module, write_pt: bool = True,
                write_npz: bool = True, index: Optional[int] = None) -> int:
    """Save one expert's (image, text) trajectories as
    ``{img,txt}_replay_buffer_{n}.{pt,npz}``; -> the index ``n`` used (the
    next free one unless ``index`` is given).  The templates (the student's
    towers) give the ravel order of the ``.npz`` files."""
    os.makedirs(save_dir, exist_ok=True)
    n = next_free_index(save_dir) if index is None else int(index)
    for kind, traj, template in (("img", img_trajectory, img_template),
                                 ("txt", txt_trajectory, txt_template)):
        stem = os.path.join(save_dir, f"{kind}_replay_buffer_{n}")
        if write_pt:
            pt = traj
            if not has_reference_order(template):
                pt = [jax_leaves(flat_to_jax(flatten_snapshot(s), template),
                                 template) for s in traj]
            save_trajectories_pt(stem + ".pt", [pt])
        if write_npz:
            save_trajectory_npz(stem + ".npz", traj, template)
    return n


def load_trajectory_npz(path: str) -> np.ndarray:
    """(epochs+1, P) in the JAX package's ravel order."""
    with np.load(path) as z:
        return z["trajectory"]


def _scalars_as_one(shapes) -> List[Tuple[int, ...]]:
    """A shape signature with ``()`` spelled ``(1,)``."""
    return [tuple(s) if len(s) else (1,) for s in shapes]


def load_trajectories_pt(path: str, template: nn.Module) -> List[np.ndarray]:
    """Load a ``.pt`` buffer -> list of stacked flat trajectories (E+1, P)
    in ``template``'s order, from snapshots in registration order or in the
    JAX tree's leaf order (tried first for a tower without a reference
    order, should the two signatures coincide).  A ``(1,)`` leaf where the
    parameter is 0-d reads as that parameter (the JAX package's files
    before round 4); any other mismatch is refused."""
    want = _scalars_as_one(tuple(p.shape) for p in template.parameters())
    native = _scalars_as_one(jax_shapes(template))
    jax_first = not has_reference_order(template)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    out = []
    for ti, traj in enumerate(payload):
        snaps = []
        for snap in traj:
            shapes = _scalars_as_one(tuple(t.shape) for t in snap)
            if shapes not in (want, native):
                raise ValueError(
                    f"{path}: trajectory {ti} holds the module's parameters "
                    f"neither in registration order nor in the JAX tree's "
                    f"order (first stored shapes {shapes[:4]}..., expected "
                    f"{want[:4]}... or {native[:4]}...)")
            snaps.append(torch.cat([t.reshape(-1).float() for t in snap]))
        flat = torch.stack(snaps).numpy()
        as_jax = shapes == native and (jax_first or shapes != want)
        out.append(flat_from_jax(flat, template) if as_jax else flat)
    return out


def discover_buffers(expert_dir: str) -> Tuple[List[str], List[str]]:
    """Scan ``{img,txt}_replay_buffer_{n}`` pairs by increasing index
    (distill.py:255-261); npz preferred when both exist."""
    img_files, txt_files = [], []
    n = 0
    while True:
        found = None
        for ext in (".npz", ".pt"):
            i = os.path.join(expert_dir, f"img_replay_buffer_{n}{ext}")
            t = os.path.join(expert_dir, f"txt_replay_buffer_{n}{ext}")
            if os.path.exists(i) and os.path.exists(t):
                found = (i, t)
                break
        if found is None:
            break
        img_files.append(found[0])
        txt_files.append(found[1])
        n += 1
    return img_files, txt_files


def load_buffer(path: str, template: nn.Module) -> List[np.ndarray]:
    """One buffer file -> list of flat trajectories (E+1, P) in
    ``template``'s order.  An ``.npz`` of another width raises the JAX
    distill CLI's ``ValueError`` (buffers written for another tower)."""
    if path.endswith(".npz"):
        traj = load_trajectory_npz(path)
        size = sum(p.numel() for p in template.parameters())
        if traj.shape[-1] != size:
            raise ValueError(
                f"expert buffer param size {traj.shape[-1]} != student flat "
                f"size {size} — buffers were written for a different image "
                f"encoder or config")
        return [flat_from_jax(traj, template)]
    return load_trajectories_pt(path, template)
