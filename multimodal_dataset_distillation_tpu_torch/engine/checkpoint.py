"""Mid-run checkpoint and resume of the outer distillation loop.

Counterpart of ``multimodal_dataset_distillation_tpu/engine/checkpoint.py``
(the reference has no resume, SURVEY.md §5.4).  ``distill_ckpt_{it}.pt``
holds the :class:`~.distill.DistillState` tensors (synthetic pixels and
embeddings, both learnable inner LRs, all three momentum traces) through
``torch.save``; the ``.meta.npz`` sidecar beside it has the JAX package's
keys: ``it``, ``n_queries``, the numpy ``RandomState``s of the host loop
and of the expert cycler, and the cycler's cursor and file lists.  In
place of ``jax_rng`` it holds ``torch_rng``, the state of the Distiller's
dropout-seed generator.  Resume restores a bit-identical outer-loop state.

The JAX package's ``.msgpack`` checkpoints (``flax.serialization``) are not
read: resuming across packages is not supported.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict

import numpy as np
import torch

from .distill import DistillState


def _rng_meta(prefix: str, rng: np.random.RandomState) -> Dict[str, Any]:
    st = rng.get_state()
    return {f"{prefix}_keys": st[1],
            f"{prefix}_pos": np.array([st[2], st[3]], np.int64),
            f"{prefix}_gauss": np.array([st[4]], np.float64)}


def _set_rng(rng: np.random.RandomState, meta, prefix: str) -> None:
    rng.set_state(("MT19937", meta[f"{prefix}_keys"],
                   int(meta[f"{prefix}_pos"][0]),
                   int(meta[f"{prefix}_pos"][1]),
                   float(meta[f"{prefix}_gauss"][0])))


def save_distill_checkpoint(path: str, distiller, it: int, cycler=None,
                            host_rng=None) -> str:
    """Write ``path`` (``.pt``) and ``path + ".meta.npz"``; -> ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    st = distiller.state
    blob = {f.name: getattr(st, f.name) for f in dataclasses.fields(st)}
    blob["mom_lr"] = list(st.mom_lr)
    torch.save({k: ([t.detach().cpu() for t in v] if isinstance(v, list)
                    else v.detach().cpu()) for k, v in blob.items()}, path)
    meta: Dict[str, Any] = {
        "it": it,
        "torch_rng": distiller.rng.get_state().numpy(),
        "n_queries": int(distiller.n_queries),
    }
    if host_rng is not None:
        meta.update(_rng_meta("np_rng", host_rng))
    if cycler is not None:
        meta["file_idx"] = cycler.file_idx
        meta["expert_idx"] = cycler.expert_idx
        meta["img_files"] = np.array(cycler.img_files)
        meta["txt_files"] = np.array(cycler.txt_files)
        meta.update(_rng_meta("cy_rng", cycler.rng))
    np.savez(path + ".meta.npz", **meta)
    return path


def load_distill_checkpoint(path: str, distiller, cycler=None,
                            host_rng=None) -> int:
    """Restore the distiller (and the cycler, the host RNG); -> ``it``."""
    if path.endswith(".msgpack"):
        raise ValueError(
            f"{path} is a checkpoint of the JAX package (flax msgpack); this "
            f"package resumes only from its own distill_ckpt_{{it}}.pt files")
    with np.load(path + ".meta.npz", allow_pickle=False) as f:
        meta = dict(f)
    if int(meta["n_queries"]) != distiller.n_queries:
        raise ValueError(
            f"checkpoint was written with num_queries="
            f"{int(meta['n_queries'])} but this run is configured for "
            f"num_queries={distiller.n_queries}")
    blob = torch.load(path, map_location="cpu", weights_only=True)
    cur = distiller.state

    def put(saved: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if saved.shape != like.shape:
            raise ValueError(f"checkpoint tensor of shape "
                             f"{tuple(saved.shape)}, expected "
                             f"{tuple(like.shape)}")
        return saved.to(device=like.device, dtype=like.dtype)

    fields = {f.name: put(blob[f.name], getattr(cur, f.name))
              for f in dataclasses.fields(cur) if f.name != "mom_lr"}
    fields["mom_lr"] = tuple(put(a, b) for a, b in zip(blob["mom_lr"],
                                                       cur.mom_lr))
    distiller.state = DistillState(**fields)
    distiller.rng.set_state(torch.from_numpy(meta["torch_rng"]))
    if host_rng is not None and "np_rng_keys" in meta:
        _set_rng(host_rng, meta, "np_rng")
    if cycler is not None and "file_idx" in meta:
        cycler.img_files = [str(x) for x in meta["img_files"]]
        cycler.txt_files = [str(x) for x in meta["txt_files"]]
        cycler.file_idx = int(meta["file_idx"])
        cycler.expert_idx = int(meta["expert_idx"])
        _set_rng(cycler.rng, meta, "cy_rng")
        cycler._load_current()
    return int(meta["it"])
