"""Expert-trajectory buffers, read side.

Counterpart of ``multimodal_dataset_distillation_tpu/engine/buffer_io.py``
(``:56-63, 97-132, 208-233`` there).  Two formats:

* ``.npz``: the stacked flat trajectory ``(epochs+1, P)`` in the JAX
  package's ravel order, remapped here to the module's flat order
  (:func:`~..models.convert.flat_from_jax`).
* ``.pt``: the reference container, a list of trajectories of snapshots of
  per-parameter tensors in ``module.parameters()`` order and torch
  layouts: this package's flat order, so snapshots concatenate as stored.
  Each snapshot's shape signature is checked against the module first, so
  a file in another order is refused instead of read permuted.

Identifying the JAX package's native-order ``.pt`` files comes with a later
slice, as does writing.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch
from torch import nn

from ..models.convert import flat_from_jax


def load_trajectory_npz(path: str) -> np.ndarray:
    """(epochs+1, P) in the JAX package's ravel order."""
    with np.load(path) as z:
        return z["trajectory"]


def load_trajectories_pt(path: str, template: nn.Module) -> List[np.ndarray]:
    """Load a ``.pt`` buffer -> list of stacked flat trajectories (E+1, P)
    in ``template``'s order."""
    want = [tuple(p.shape) for p in template.parameters()]
    payload = torch.load(path, map_location="cpu", weights_only=True)
    out = []
    for ti, traj in enumerate(payload):
        snaps = []
        for snap in traj:
            shapes = [tuple(t.shape) for t in snap]
            if shapes != want:
                raise ValueError(
                    f"{path}: trajectory {ti} does not hold the module's "
                    f"parameters in registration order (first stored shapes "
                    f"{shapes[:4]}..., expected {want[:4]}...)")
            snaps.append(torch.cat([t.reshape(-1).float() for t in snap]))
        out.append(torch.stack(snaps).numpy())
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
    ``template``'s order."""
    if path.endswith(".npz"):
        return [flat_from_jax(load_trajectory_npz(path), template)]
    return load_trajectories_pt(path, template)
