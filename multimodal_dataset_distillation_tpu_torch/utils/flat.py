"""Flat parameter vectors <-> named parameter views.

The torch counterpart of ``jax.flatten_util.ravel_pytree`` in the JAX
package (and of the reference's ``ReparamModule``): a student is one flat
float32 vector, and a forward pass is ``torch.func.functional_call`` over
views of it.  Flat order is module registration order
(``named_parameters()``), in torch layouts: the reference's
``module.parameters()`` order, which the JAX package's ``.pt`` buffers use
(``engine/buffer_io.py:168-197`` there).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
from torch import nn


class FlatParams:
    """Layout of a module's parameters in one flat vector."""

    def __init__(self, module: nn.Module):
        self.names: List[str] = []
        self.shapes: List[torch.Size] = []
        for name, p in module.named_parameters():
            self.names.append(name)
            self.shapes.append(p.shape)
        self.sizes = [s.numel() for s in self.shapes]

    def unflatten(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Named views of ``flat``.  One ``split``, so the backward is one
        concatenation rather than a zero-filled vector per parameter."""
        return {n: t.view(s) for n, s, t in
                zip(self.names, self.shapes, flat.split(self.sizes))}


def flatten_params(module: nn.Module) -> torch.Tensor:
    """The module's parameters as one detached flat vector."""
    return torch.cat([p.detach().reshape(-1) for p in module.parameters()])


def make_unravel(module: nn.Module) -> Tuple[int, Callable[[torch.Tensor],
                                                          Dict[str, torch.Tensor]]]:
    """(flat size, unflatten) of a module's parameters: the counterpart of
    the JAX package's ``make_unravel`` (size + unravel function)."""
    layout = FlatParams(module)
    return sum(layout.sizes), layout.unflatten
