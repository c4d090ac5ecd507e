"""Weights and flat vectors carried across from the JAX package.

The JAX package keeps parameters in a flax tree (dict keys sorted when
raveled, conv kernels HWIO, Dense kernels (in, out), gains (out,), SE as
Dense); this package keeps timm names in registration order and torch
layouts (OIHW, (out, in), gains (out, 1, 1, 1), SE as 1x1 convs).  This
module maps one to the other, for :class:`~.nfnet.NormFreeNet`,
:class:`~.zoo.ImageTower` and :class:`~.projection.ProjectionHead`
(the port's own copy of the mapping in ``models/import_torch.py:127-176``
and ``models/torch_order.py`` there).

* :func:`params_from_jax` turns a JAX parameter tree (numpy leaves) into
  the module's state dict.
* :func:`flat_from_jax` / :func:`flat_to_jax` map a JAX ravel-order flat
  vector (``.npz`` buffers, ``Distiller.unroll`` outputs) to and from the
  module's flat order, over the last axis.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from .layers import WSConv

# flax's auto-name of the network inside the JAX ImageTower
_JAX_TOWER_KEY = "NormFreeNet_0"


def _jax_module_path(mod_name: str) -> Tuple[str, ...]:
    """Port module name -> flax module path."""
    parts = mod_name.split(".") if mod_name else []
    path: List[str] = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if p == "model":
            path.append(_JAX_TOWER_KEY)
        elif p == "stem":
            path.append(f"stem_{parts[i + 1]}")
            i += 1
        elif p == "stages":
            path.append(f"stage{parts[i + 1]}_block{parts[i + 2]}")
            i += 2
        elif p == "downsample":
            path.append("downsample_conv")
            i += 1  # timm's downsample.conv is flax's downsample_conv
        elif p == "attn_last":
            path.append("se")
        else:
            path.append(p)
        i += 1
    return tuple(path)


def _leaf(mod: nn.Module, pname: str) -> Tuple[str, str]:
    """(flax leaf name, layout kind) of a module's direct parameter."""
    if pname != "weight":
        return pname, ("gain" if pname == "gain" else "plain")
    if isinstance(mod, WSConv):
        return "kernel", "conv"
    if isinstance(mod, nn.Conv2d):  # SE fc, a flax Dense
        return "kernel", "se_fc"
    if isinstance(mod, nn.Linear):
        return "kernel", "linear"
    if isinstance(mod, nn.LayerNorm):
        return "scale", "plain"
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
    out = []
    for mod_name, mod in module.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            leaf, kind = _leaf(mod, pname)
            shape = tuple(p.shape)
            out.append((f"{mod_name}.{pname}" if mod_name else pname, shape,
                        _jax_module_path(mod_name) + (leaf,),
                        _jax_shape(kind, shape), kind))
    return out


def params_from_jax(tree: Mapping[str, Any],
                    module: nn.Module) -> Dict[str, torch.Tensor]:
    """JAX parameter (sub)tree of ``module`` -> the module's state dict."""
    sd: Dict[str, torch.Tensor] = {}
    for name, shape, path, jshape, kind in _entries(module):
        leaf = tree
        for k in path:
            leaf = leaf[k]
        a = np.asarray(leaf)
        if a.shape != jshape:
            raise ValueError(f"{'/'.join(path)}: JAX shape {a.shape}, "
                             f"expected {jshape} for {name}")
        sd[name] = torch.tensor(np.ascontiguousarray(_to_torch(kind, a, shape)))
    return sd


def _permutation(module: nn.Module) -> np.ndarray:
    """perm with port_flat = jax_flat[perm]."""
    entries = _entries(module)
    # jax.flatten_util.ravel_pytree visits dict keys in sorted order at
    # every level: the lexicographic order of the key paths
    offsets = {}
    off = 0
    for _, _, path, jshape, _ in sorted(entries, key=lambda e: e[2]):
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
