"""Weights and flat vectors carried across from the JAX package.

The JAX package keeps parameters in a flax tree (dict keys sorted when
raveled, conv kernels HWIO, Dense kernels (in, out), gains (out,), SE as
Dense); this package keeps timm names in registration order and torch
layouts (OIHW, (out, in), gains (out, 1, 1, 1), SE as 1x1 convs).  This
module maps one to the other, for every network of :mod:`.zoo` and the
:class:`~.zoo.ImageTower` around it (CLIP ViT-B/32 and ConvNeXt-Tiny
included), :class:`~.projection.ProjectionHead`, the frozen
:class:`~.clip_text.ClipTextTransformer`, :class:`~.modified_resnet.
ModifiedResNet` and :class:`~.bert.BertEncoder` (the port's own copy of the
mappings in ``models/import_torch.py`` and ``models/torch_order.py`` there;
the BERT names are those of ``models/bert.py`` there).  Flax Dense kernels
(in, out) become Linear weights (out, in), conv kernels HWIO become OIHW,
norm ``scale`` becomes ``weight``; a module's direct parameters (CLIP's
``class_embedding``, ``positional_embedding``, ``proj`` and
``text_projection``, ConvNeXt's ``gamma``) keep the flax layout.

A module's flax path follows its port name, renamed where a module says
so: a module's ``jax_names`` maps a child's (dotted) name to the flax
module name it stands for (``ImageTower``'s ``model`` -> the flax
auto-name ``NormFreeNet_0`` / ``ConvNet_0`` / ``ResNet_0`` /
``VisionTransformer_0`` / ``ClipVisionTransformer_0`` / ``ConvNeXt_0``,
timm's ``stages.0.1`` -> ``stage0_block1``, a
ResNet block's ``downsample.1`` -> ``shortcut_bn``, ...).  Leaves: conv
and dense kernels ``kernel``, norm weights ``scale``; BatchNorm's running
averages are the ``batch_stats`` collection's ``mean`` / ``var``.

* :func:`params_from_jax` turns a JAX parameter tree (numpy leaves), and
  a ``batch_stats`` tree where the module has BatchNorms, into the
  module's state dict.
* :func:`flat_from_jax` / :func:`flat_to_jax` map a JAX ravel-order flat
  vector (``.npz`` buffers, ``Distiller.unroll`` outputs) to and from the
  module's flat order, over the last axis; :func:`jax_shapes` /
  :func:`jax_leaves` give the JAX tree's leaves in that order.
* :func:`bert_state_dict_from_jax` turns the JAX ``BertEncoder`` tree into
  the state dict of :class:`~.bert.BertEncoder`.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .bert import BertEncoder
from .layers import BatchNorm, WSConv

def _jax_module_path(root: nn.Module, mod_name: str) -> Tuple[str, ...]:
    """Port module name -> flax module path, through the ``jax_names`` of
    the modules on the way (the longest dotted match first)."""
    parts = mod_name.split(".") if mod_name else []
    path: List[str] = []
    mod, i = root, 0
    while i < len(parts):
        names = getattr(mod, "jax_names", {})
        for j in range(len(parts), i, -1):
            key = ".".join(parts[i:j])
            if key in names:
                path.append(names[key])
                break
        else:
            j = i + 1
            path.append(parts[i])
        for p in parts[i:j]:
            mod = getattr(mod, p) if not p.isdigit() else mod[int(p)]
        i = j
    return tuple(path)


# BertEncoder's per-layer modules -> the JAX BertLayer's names
_BERT_LAYER = {"attention.output.dense": "attention_output",
               "attention.output.LayerNorm": "attention_norm",
               "intermediate.dense": "intermediate", "output.dense": "output",
               "output.LayerNorm": "output_norm"}


def _bert_module_path(mod_name: str) -> Tuple[str, ...]:
    """BertEncoder module name (HF's) -> flax module path."""
    if mod_name.startswith("embeddings."):
        rest = mod_name[len("embeddings."):]
        return ("embeddings_norm",) if rest == "LayerNorm" else (rest,)
    i, rest = re.fullmatch(r"encoder\.layer\.(\d+)\.(.+)", mod_name).groups()
    if rest.startswith("attention.self."):
        return (f"layer{i}", "attention", rest.rsplit(".", 1)[1])
    return (f"layer{i}", _BERT_LAYER[rest])


def _leaf(mod: nn.Module, pname: str) -> Tuple[str, str]:
    """(flax leaf name, layout kind) of a module's direct parameter."""
    if pname != "weight":
        return pname, ("gain" if pname == "gain" else "plain")
    if isinstance(mod, WSConv):
        return "kernel", "conv"
    if isinstance(mod, nn.Conv2d):  # an SE fc is a flax Dense
        return "kernel", ("se_fc" if getattr(mod, "jax_dense", False)
                          else "conv")
    if isinstance(mod, nn.Linear):
        return "kernel", "linear"
    if isinstance(mod, (nn.LayerNorm, nn.GroupNorm, BatchNorm)):
        return "scale", "plain"
    if isinstance(mod, nn.Embedding):
        return "embedding", "plain"
    raise TypeError(f"no JAX counterpart for {type(mod).__name__}.weight")


def _to_torch(kind: str, a: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    if kind == "conv":
        return np.transpose(a, (3, 2, 0, 1))
    if kind == "linear":
        return a.T
    if kind == "se_fc":
        return a.T[:, :, None, None]
    return a.reshape(shape)


def _jax_shape(kind: str, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    if kind == "conv":
        o, i, kh, kw = shape
        return (kh, kw, i, o)
    if kind in ("linear", "se_fc"):
        return (shape[1], shape[0])
    if kind == "gain":
        return (shape[0],)
    return tuple(shape)


def _entries(module: nn.Module):
    """[(name, torch shape, flax path, flax shape, kind)] in the order of
    ``module.named_parameters()`` (pre-order, direct parameters first)."""
    if isinstance(module, BertEncoder):
        path_of = _bert_module_path
    else:
        def path_of(name):
            return _jax_module_path(module, name)
    out = []
    for mod_name, mod in module.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            leaf, kind = _leaf(mod, pname)
            shape = tuple(p.shape)
            out.append((f"{mod_name}.{pname}" if mod_name else pname, shape,
                        path_of(mod_name) + (leaf,),
                        _jax_shape(kind, shape), kind))
    return out


def _get(tree: Mapping[str, Any], path: Tuple[str, ...]) -> np.ndarray:
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def params_from_jax(tree: Mapping[str, Any], module: nn.Module,
                    batch_stats: Optional[Mapping[str, Any]] = None
                    ) -> Dict[str, torch.Tensor]:
    """JAX parameter (sub)tree of ``module`` -> the module's state dict;
    with ``batch_stats`` (the same subtree of that collection) the
    BatchNorms' running averages too."""
    sd: Dict[str, torch.Tensor] = {}
    for name, shape, path, jshape, kind in _entries(module):
        a = _get(tree, path)
        if a.shape != jshape:
            raise ValueError(f"{'/'.join(path)}: JAX shape {a.shape}, "
                             f"expected {jshape} for {name}")
        sd[name] = torch.tensor(np.ascontiguousarray(_to_torch(kind, a, shape)))
    if batch_stats is not None:
        for mod_name, mod in module.named_modules():
            if isinstance(mod, BatchNorm):
                path = _jax_module_path(module, mod_name)
                pre = f"{mod_name}." if mod_name else ""
                for buf, leaf in (("running_mean", "mean"),
                                  ("running_var", "var")):
                    sd[pre + buf] = torch.tensor(
                        _get(batch_stats, path + (leaf,)), dtype=torch.float32)
    return sd


def _jax_order(module: nn.Module):
    """The entries in the JAX tree's leaf order: jax.flatten_util.ravel_pytree
    visits dict keys in sorted order at every level, the lexicographic
    order of the key paths."""
    return sorted(_entries(module), key=lambda e: e[2])


def jax_shapes(module: nn.Module) -> List[Tuple[int, ...]]:
    """Shapes of the JAX tree's leaves, in its ravel order."""
    return [jshape for _, _, _, jshape, _ in _jax_order(module)]


def jax_leaves(flat: np.ndarray, module: nn.Module) -> List[np.ndarray]:
    """A JAX ravel-order flat vector -> the JAX tree's leaves (its order
    and shapes)."""
    shapes = jax_shapes(module)
    sizes = [int(np.prod(s, dtype=np.int64)) for s in shapes]
    return [x.reshape(s) for x, s in zip(
        np.split(np.asarray(flat), np.cumsum(sizes)[:-1]), shapes)]


def _permutation(module: nn.Module) -> np.ndarray:
    """perm with port_flat = jax_flat[perm]."""
    entries = _entries(module)
    offsets = {}
    off = 0
    for _, _, path, jshape, _ in _jax_order(module):
        offsets[path] = off
        off += int(np.prod(jshape, dtype=np.int64))
    pieces = []
    for _, shape, path, jshape, kind in entries:
        n = int(np.prod(jshape, dtype=np.int64))
        idx = np.arange(offsets[path], offsets[path] + n).reshape(jshape)
        pieces.append(_to_torch(kind, idx, shape).reshape(-1))
    return np.concatenate(pieces)


def flat_from_jax(flat: np.ndarray, module: nn.Module) -> np.ndarray:
    """JAX ravel-order flat vector(s) (last axis) -> the module's order."""
    flat = np.asarray(flat)
    perm = _permutation(module)
    if flat.shape[-1] != perm.size:
        raise ValueError(f"flat size {flat.shape[-1]} != module size "
                         f"{perm.size}")
    return flat[..., perm]


def bert_state_dict_from_jax(params: Mapping[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """The JAX ``BertEncoder``'s parameter tree -> the state dict of
    :class:`~.bert.BertEncoder` (HF names; Dense kernels transposed)."""
    def t(a):
        return torch.tensor(np.ascontiguousarray(np.asarray(a)))

    def dense(tree):
        return t(np.asarray(tree["kernel"]).T), t(tree["bias"])

    def norm(tree):
        return t(tree["scale"]), t(tree["bias"])

    sd: Dict[str, torch.Tensor] = {}

    def put(prefix, pair):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = pair

    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        sd[f"embeddings.{name}.weight"] = t(params[name]["embedding"])
    put("embeddings.LayerNorm", norm(params["embeddings_norm"]))
    i = 0
    while f"layer{i}" in params:
        p, q = params[f"layer{i}"], f"encoder.layer.{i}"
        for k in ("query", "key", "value"):
            put(f"{q}.attention.self.{k}", dense(p["attention"][k]))
        put(f"{q}.attention.output.dense", dense(p["attention_output"]))
        put(f"{q}.attention.output.LayerNorm", norm(p["attention_norm"]))
        put(f"{q}.intermediate.dense", dense(p["intermediate"]))
        put(f"{q}.output.dense", dense(p["output"]))
        put(f"{q}.output.LayerNorm", norm(p["output_norm"]))
        i += 1
    return sd


def flat_to_jax(flat: np.ndarray, module: nn.Module) -> np.ndarray:
    """The module's flat order -> JAX ravel order (last axis)."""
    flat = np.asarray(flat)
    perm = _permutation(module)
    if flat.shape[-1] != perm.size:
        raise ValueError(f"flat size {flat.shape[-1]} != module size "
                         f"{perm.size}")
    out = np.empty_like(flat)
    out[..., perm] = flat
    return out
