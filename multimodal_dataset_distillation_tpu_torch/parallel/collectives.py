"""The collectives of the data-parallel engines, on ``torch.distributed``.

What GSPMD inserts into the JAX package's programs, the port calls here.
The convention: a tensor is either *replicated* (every rank holds the same
value, e.g. the students' parameters or the gathered embeddings) or
*local* (this rank's rows).  A gradient of a replicated tensor is whole on
every rank; a gradient of a local tensor is this rank's.  Four
``autograd.Function`` pairs keep to that convention in reverse and in
forward mode, each backward and each ``jvp`` built from ``.apply`` of
another, so that the reverse pass over a jvp (``fr_bwd="rof"``), the jvp
of a gradient (``"for"``) and a double backward stay exact:

* :func:`gather_rows` (local -> replicated): the all-gather along dim 0;
  backward the rank's own slice of the incoming gradient, which is whole
  on every rank (not a sum).  :func:`slice_rows` is its transpose.
* :func:`copy_to_ranks` (replicated -> local use): the identity; backward
  the sum over ranks of the gradients, since each rank's holds only the
  paths through its rows.  :func:`sum_ranks` (the sum of local partial
  values, which is replicated) is its transpose.

Parameter gradients outside autograd are summed with
:func:`all_reduce_sum` (not DDP's mean: the loss is the global one, and
each rank's gradient is its rows' part of it); the ``--shard_syn``
meta-gradient is reduce-scattered with :func:`reduce_scatter_rows`.

On ``gloo`` an all-gather is an all-reduce of disjoint slices and a
reduce-scatter an all-reduce and a slice: gloo takes CUDA tensors in
``all_reduce`` and ``broadcast``, where its ``all_gather`` and
``reduce_scatter`` vary between releases.  A collective that fails
raises.  At world 1 every function is the identity.
"""

from __future__ import annotations

import contextlib
import hashlib
from typing import Any, Iterator, List

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh


def _gloo(mesh: Mesh) -> bool:
    return mesh.backend == "gloo"


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``t`` over the ranks (a new tensor; not differentiable)."""
    if mesh.world == 1:
        return t
    out = t.detach().clone().contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    return out


def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) stacked along dim 0, in rank
    order (not differentiable)."""
    if mesh.world == 1:
        return t
    t = t.detach().contiguous()
    n = t.shape[0]
    if _gloo(mesh):
        out = torch.zeros((n * mesh.world,) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        out[mesh.rank * n:(mesh.rank + 1) * n] = t
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
        return out
    out = torch.empty((n * mesh.world,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out, t, group=mesh.group)
    return out


def reduce_scatter_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of the sum of ``t`` over the ranks (dim 0 split in
    equal parts; not differentiable)."""
    if mesh.world == 1:
        return t
    n = t.shape[0] // mesh.world
    if t.shape[0] % mesh.world:
        raise ValueError(f"{t.shape[0]} rows do not split over "
                         f"{mesh.world} ranks")
    if _gloo(mesh):
        return all_reduce_sum(t, mesh)[mesh.rank * n:(mesh.rank + 1) * n]
    out = torch.empty((n,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.reduce_scatter_tensor(out, t.detach().contiguous(),
                               op=dist.ReduceOp.SUM, group=mesh.group)
    return out


def _own_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    n = t.shape[0] // mesh.world
    return t[mesh.rank * n:(mesh.rank + 1) * n]


class GatherRows(torch.autograd.Function):
    """Local rows -> the replicated batch (all-gather along dim 0)."""

    @staticmethod
    def forward(t, mesh):
        return all_gather_rows(t, mesh)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh = inputs[1]
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, g):
        return (None if g is None else SliceRows.apply(g, ctx.mesh)), None

    @staticmethod
    def jvp(ctx, tdot, _):
        return None if tdot is None else GatherRows.apply(tdot, ctx.mesh)


class SliceRows(torch.autograd.Function):
    """A replicated batch -> this rank's rows (the transpose of
    :class:`GatherRows`)."""

    @staticmethod
    def forward(t, mesh):
        return _own_rows(t, mesh).clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh = inputs[1]
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, g):
        return (None if g is None else GatherRows.apply(g, ctx.mesh)), None

    @staticmethod
    def jvp(ctx, tdot, _):
        return None if tdot is None else SliceRows.apply(tdot, ctx.mesh)


class CopyToRanks(torch.autograd.Function):
    """A replicated tensor entering local computation: the identity, its
    gradient summed over the ranks."""

    @staticmethod
    def forward(t, mesh):
        return t.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh = inputs[1]
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, g):
        return (None if g is None else SumRanks.apply(g, ctx.mesh)), None

    @staticmethod
    def jvp(ctx, tdot, _):
        return None if tdot is None else CopyToRanks.apply(tdot, ctx.mesh)


class SumRanks(torch.autograd.Function):
    """The sum over the ranks of local partial values (replicated); the
    transpose of :class:`CopyToRanks`."""

    @staticmethod
    def forward(t, mesh):
        return all_reduce_sum(t, mesh)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh = inputs[1]
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, g):
        return (None if g is None else CopyToRanks.apply(g, ctx.mesh)), None

    @staticmethod
    def jvp(ctx, tdot, _):
        return None if tdot is None else SumRanks.apply(tdot, ctx.mesh)


def gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Differentiable all-gather of local rows (identity at world 1)."""
    return t if mesh.world == 1 else GatherRows.apply(t, mesh)


def slice_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Differentiable cut of a replicated batch to this rank's rows."""
    return t if mesh.world == 1 else SliceRows.apply(t, mesh)


def copy_to_ranks(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A replicated tensor used on local rows (identity at world 1)."""
    return t if mesh.world == 1 else CopyToRanks.apply(t, mesh)


def sum_ranks(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Differentiable sum of local partial values over the ranks."""
    return t if mesh.world == 1 else SumRanks.apply(t, mesh)


def synced_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A sum over the ranks that local computation then uses (a batch
    statistic): all-reduce forward and backward."""
    return copy_to_ranks(sum_ranks(t, mesh), mesh)


# ---- host objects -------------------------------------------------------

def _object_device(mesh: Mesh) -> torch.device:
    return mesh.device if mesh.backend == "nccl" else torch.device("cpu")


def broadcast_object(obj: Any, mesh: Mesh, src: int = 0) -> Any:
    """Rank ``src``'s picklable ``obj`` on every rank (within ``mesh``)."""
    if mesh.world == 1:
        return obj
    box = [obj if mesh.rank == src else None]
    dist.broadcast_object_list(box, src=dist.get_global_rank(
        mesh.group, src) if mesh.group is not dist.group.WORLD else src,
        group=mesh.group, device=_object_device(mesh))
    return box[0]


def all_gather_object(obj: Any, mesh: Mesh) -> List[Any]:
    """Every rank's picklable ``obj``, in rank order."""
    if mesh.world == 1:
        return [obj]
    out: List[Any] = [None] * mesh.world
    if mesh.backend == "nccl":
        torch.cuda.set_device(mesh.device)
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def agree(flag: bool, mesh: Mesh) -> bool:
    """True on every rank when ``flag`` is true on any (a NaN seen by one
    rank stops them all)."""
    if mesh.world == 1:
        return bool(flag)
    t = torch.tensor([1.0 if flag else 0.0], device=_object_device(mesh))
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return bool(t.item() > 0)


def barrier(mesh: Mesh) -> None:
    if mesh.world > 1:
        if mesh.backend == "nccl":
            dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
        else:
            dist.barrier(group=mesh.group)


@contextlib.contextmanager
def main_first(mesh: Mesh) -> Iterator[None]:
    """Rank 0 runs the block first (it writes a cache or a file), the
    other ranks after it (they read what it wrote)."""
    if not mesh.is_main:
        barrier(mesh)
    yield
    if mesh.is_main:
        barrier(mesh)


def check_replicated(t: torch.Tensor, mesh: Mesh, what: str) -> None:
    """Raise unless ``t`` is bit-identical on every rank."""
    if mesh.world == 1:
        return
    blob = np.ascontiguousarray(t.detach().cpu().numpy()).tobytes()
    digests = all_gather_object(hashlib.sha256(blob).hexdigest(), mesh)
    if len(set(digests)) != 1:
        raise RuntimeError(f"{what} differs between ranks")
