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

``--resume_from`` also takes the JAX package's ``distill_ckpt_{it}.msgpack``
(``flax.serialization.to_bytes`` of its ``DistillState``), read with
``msgpack`` alone (:func:`read_flax_msgpack`, no flax): the synthetic
pixels (NHWC in both packages) and embeddings, both inner LRs, and the
optax ``sgd(momentum=0.5)`` traces of ``opt_img`` / ``opt_txt`` / ``opt_lr``
as ``mom_img`` / ``mom_txt`` / ``mom_lr``.  The mesh's padding rows
(``--shard_syn``) are cut to ``n_queries``, as the JAX ``_repad_syn_rows``
does for a run on one device.  From its ``.meta.npz`` the keys the two
packages share are read; its ``jax_rng`` has no torch counterpart, so the
dropout-seed generator starts from the config's seed, as in a fresh run.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict

import numpy as np
import torch

from .distill import DistillState

#: flax's msgpack ext codes for an ndarray and a numpy scalar (both packed
#: as ``(shape, dtype name, buffer)``)
_FLAX_NDARRAY, _FLAX_NPSCALAR = 1, 3
_FLAX_CHUNKED = "__msgpack_chunked_array__"


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


def _flax_array(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype, buf = msgpack.unpackb(data, raw=True)
    if dtype == b"bfloat16":   # numpy has no bfloat16
        return (torch.frombuffer(bytearray(buf), dtype=torch.bfloat16)
                .float().numpy().reshape(shape))
    return np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(shape)


def read_flax_msgpack(path: str) -> Dict[str, Any]:
    """``flax.serialization.to_bytes`` output -> its state dict (nested
    dicts of numpy arrays), decoded with ``msgpack`` alone.  A leaf that
    flax split into chunks (one over 2**30 bytes) is refused."""
    try:
        import msgpack
    except ImportError as e:
        raise ValueError(
            f"{path}: reading a checkpoint of the JAX package needs the "
            f"msgpack package, which is not installed") from e

    def ext(code, data):
        if code in (_FLAX_NDARRAY, _FLAX_NPSCALAR):
            return _flax_array(data)
        raise ValueError(f"{path}: msgpack ext type {code} is not an array")

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=ext, raw=False)

    def check(node, where):
        if isinstance(node, dict):
            if _FLAX_CHUNKED in node:
                raise ValueError(
                    f"{path}: leaf {where} was written in chunks (flax "
                    f"splits a leaf over 2**30 bytes); chunked leaves are "
                    f"not read")
            for k, v in node.items():
                check(v, f"{where}/{k}")

    check(tree, "")
    return tree


def _momentum_trace(opt_state: Dict[str, Any], name: str):
    """The one ``trace`` of an optax ``sgd(momentum=...)`` state, alone or
    chained after ``clip_by_global_norm`` (``--max_grad_norm``)."""
    found = []

    def walk(node):
        if isinstance(node, dict):
            if "trace" in node:
                found.append(node["trace"])
            for v in node.values():
                walk(v)

    walk(opt_state)
    if len(found) != 1:
        raise ValueError(f"{name}: expected one optax momentum trace, "
                         f"found {len(found)}")
    return found[0]


def _jax_state_blob(path: str, n_queries: int) -> Dict[str, Any]:
    """The JAX ``DistillState`` of a ``.msgpack`` checkpoint under this
    package's field names, with the mesh's padding rows cut off."""
    st = read_flax_msgpack(path)
    rows = int(np.shape(st["image_syn"])[0])
    if rows < n_queries:
        raise ValueError(
            f"checkpoint synthetic set has {rows} rows but this run is "
            f"configured for num_queries={n_queries}: wrong checkpoint?")

    def rows_of(x):
        return torch.from_numpy(np.array(x[:n_queries]))

    lr_trace = _momentum_trace(st["opt_lr"], "opt_lr")
    return {
        "image_syn": rows_of(st["image_syn"]),
        "text_syn": rows_of(st["text_syn"]),
        "syn_lr_img": torch.from_numpy(np.array(st["syn_lr_img"])),
        "syn_lr_txt": torch.from_numpy(np.array(st["syn_lr_txt"])),
        "mom_img": rows_of(_momentum_trace(st["opt_img"], "opt_img")),
        "mom_txt": rows_of(_momentum_trace(st["opt_txt"], "opt_txt")),
        "mom_lr": [torch.from_numpy(np.array(lr_trace[k]))
                   for k in ("0", "1")],
    }


def load_distill_checkpoint(path: str, distiller, cycler=None,
                            host_rng=None) -> int:
    """Restore the distiller (and the cycler, the host RNG) from this
    package's ``.pt`` or the JAX package's ``.msgpack``; -> ``it``."""
    with np.load(path + ".meta.npz", allow_pickle=False) as f:
        meta = dict(f)
    # the JAX package's checkpoints before it recorded n_queries lack it
    if int(meta.get("n_queries", distiller.n_queries)) != distiller.n_queries:
        raise ValueError(
            f"checkpoint was written with num_queries="
            f"{int(meta['n_queries'])} but this run is configured for "
            f"num_queries={distiller.n_queries}")
    from_jax = path.endswith(".msgpack")
    if from_jax:
        blob = _jax_state_blob(path, distiller.n_queries)
    else:
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
    if from_jax:
        print(f"{path}: the JAX package's jax_rng has no torch counterpart; "
              f"dropout seeds start from seed {distiller.cfg.seed}, as in a "
              f"fresh run")
        distiller.rng.manual_seed(distiller.cfg.seed)
    else:
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
