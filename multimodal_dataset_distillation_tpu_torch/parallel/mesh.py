"""Ranks, process groups and the ``data`` axis: data parallelism across
cards and processes on ``torch.distributed``.

Counterpart of ``multimodal_dataset_distillation_tpu/parallel/mesh.py``.
There a single jitted program spans a :class:`jax.sharding.Mesh`: batches
shard over the ``data`` axis, parameters replicate and XLA inserts the
collectives.  Here each card runs its own process (torchrun's
environment), and the engines call the collectives of
:mod:`.collectives` themselves.  The mapping: a JAX *process* (a host) is
a node; a JAX *local device* is a rank on that node.

* ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` come
  from torchrun; nodes = ``WORLD_SIZE / LOCAL_WORLD_SIZE``.  Each rank
  takes the card ``LOCAL_RANK``.
* The backend is ``nccl`` when every rank has a card of its own and
  ``gloo`` on the CPU.  Ranks that share a card need ``gloo`` asked for
  (``backend="gloo"``, or ``MDD_DIST_BACKEND=gloo``): NCCL refuses two
  ranks on one device.
* A single process that sees more than one card raises: launch one
  process per card (``torchrun --nproc_per_node=N``).

The data axis is the whole world: the JAX package's ``model`` axis is
provisioned but computes nothing different, so a ``--mesh_shape`` with a
non-``data`` axis above 1 raises.

The JAX module's ``setup_compilation_cache`` has no counterpart: the
kernels' nvcc build cache (:func:`..ops.gconv.build`) already keeps
compiled code across runs.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

#: the environment variable that names the backend (``nccl`` / ``gloo``)
BACKEND_ENV = "MDD_DIST_BACKEND"
#: how long a collective waits for the other ranks: the CLIs' eval blocks
#: and test passes run on rank 0 alone (minutes at full width) while the
#: others wait at the next collective
TIMEOUT = datetime.timedelta(seconds=1800)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a group of ranks that run one data-parallel
    program: ``world`` ranks on the ``data`` axis, this one ``rank``;
    ``local_world`` ranks per node, this one ``local_rank`` on node
    ``node``.  ``group`` is the process group of the ranks (None at world
    1, where every collective is the identity)."""

    world: int = 1
    rank: int = 0
    local_rank: int = 0
    local_world: int = 1
    backend: str = ""
    device: torch.device = torch.device("cpu")
    group: Optional[object] = None

    @property
    def nodes(self) -> int:
        return self.world // self.local_world

    @property
    def node(self) -> int:
        return self.rank // self.local_world

    @property
    def data(self) -> int:
        """The size of the ``data`` axis (the world)."""
        return self.world

    @property
    def shape(self) -> dict:
        return {"data": self.world}

    @property
    def is_main(self) -> bool:
        """Rank 0, the one that writes files."""
        return self.rank == 0

    def rows(self, n: int) -> Tuple[int, int]:
        """This rank's [start, stop) of ``n`` rows split in equal parts."""
        if n % self.world:
            raise ValueError(f"{n} rows do not split over {self.world} ranks")
        per = n // self.world
        return self.rank * per, (self.rank + 1) * per


#: the mesh of a single process: every collective is the identity
SINGLE = Mesh()


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def maybe_init_distributed(device: str = "cuda", backend: str = "",
                           init_method: Optional[str] = None) -> None:
    """Join the process group that torchrun's environment describes (a
    no-op at ``WORLD_SIZE`` 1 or when this process has joined one).

    The live counterpart of the JAX ``maybe_init_distributed``.  Checks
    come first, so a bad launch raises before any rank waits on another:
    more than one visible card in a single process raises with the
    torchrun hint; ranks that share a card without ``gloo`` raise.
    ``init_method`` defaults to ``env://`` (torchrun's ``MASTER_ADDR`` and
    ``MASTER_PORT``)."""
    if dist.is_initialized():
        return
    world = _env_int("WORLD_SIZE", 1)
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.is_available():
        cards = torch.cuda.device_count()
        if world == 1 and cards > 1:
            raise RuntimeError(
                f"{cards} cards are visible to one process; launch one "
                f"process per card (torchrun --nproc_per_node={cards} "
                f"<script> ...), or show this process one card "
                f"(CUDA_VISIBLE_DEVICES)")
    if world == 1:
        return
    backend = resolve_backend(dev, backend)
    dist.init_process_group(backend=backend,
                            init_method=init_method or "env://",
                            world_size=world, rank=_env_int("RANK", 0),
                            timeout=TIMEOUT)


def resolve_backend(device: torch.device, backend: str = "") -> str:
    """``backend`` or ``MDD_DIST_BACKEND`` when set, else ``nccl`` for
    cards and ``gloo`` for the CPU; raises for ranks that share a card on
    ``nccl``."""
    backend = backend or os.environ.get(BACKEND_ENV, "")
    if device.type != "cuda":
        if backend not in ("", "gloo"):
            raise ValueError(f"backend {backend!r} on the CPU: only gloo "
                             f"runs there")
        return "gloo"
    local_world = _env_int("LOCAL_WORLD_SIZE", _env_int("WORLD_SIZE", 1))
    cards = torch.cuda.device_count()
    if local_world > cards and backend != "gloo":
        raise RuntimeError(
            f"{local_world} ranks on this node share {cards} card(s): NCCL "
            f"refuses two ranks on one device; ask for gloo explicitly "
            f"({BACKEND_ENV}=gloo) or run one rank per card")
    if backend not in ("", "nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    return backend or "nccl"


def check_mesh_shape(mesh_shape: Sequence[int] = (),
                     axis_names: Sequence[str] = ("data",)) -> None:
    """Raise ``ValueError`` unless ``mesh_shape`` (empty: the whole world
    on ``data``) multiplies to the world and puts no rank on another
    axis; the world is the process group's, or ``WORLD_SIZE`` before one
    is joined."""
    axis_names = tuple(axis_names) or ("data",)
    mesh_shape = tuple(int(n) for n in mesh_shape)
    if mesh_shape:
        if len(mesh_shape) != len(axis_names):
            raise ValueError(f"--mesh_shape {mesh_shape} and --mesh_axes "
                             f"{axis_names} differ in length")
        for n, name in zip(mesh_shape, axis_names):
            if name != "data" and n > 1:
                raise ValueError(
                    f"--mesh_shape axis {name!r} of size {n}: only the "
                    f"'data' axis is run; the JAX package provisions a "
                    f"'model' axis but computes nothing different on it")
    world = (dist.get_world_size() if dist.is_initialized()
             else _env_int("WORLD_SIZE", 1))
    if mesh_shape and int(np.prod(mesh_shape)) != world:
        raise ValueError(f"--mesh_shape {mesh_shape} multiplies to "
                         f"{int(np.prod(mesh_shape))}, but the world has "
                         f"{world} rank(s)")


def get_mesh(mesh_shape: Sequence[int] = (),
             axis_names: Sequence[str] = ("data",),
             device: str = "cuda", backend: str = "",
             init_method: Optional[str] = None) -> Mesh:
    """The mesh of this process: checks ``mesh_shape``
    (:func:`check_mesh_shape`), joins the process group
    (:func:`maybe_init_distributed`) and takes the card ``LOCAL_RANK``.
    ``device`` is the run's (``cfg.device``)."""
    check_mesh_shape(mesh_shape, axis_names)
    maybe_init_distributed(device, backend, init_method)
    dev = torch.device(device)
    local_rank = _env_int("LOCAL_RANK", 0)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        return dataclasses.replace(SINGLE, device=dev)
    world, rank = dist.get_world_size(), dist.get_rank()
    local_world = _env_int("LOCAL_WORLD_SIZE", world)
    if world % local_world:
        raise ValueError(f"LOCAL_WORLD_SIZE {local_world} does not divide "
                         f"WORLD_SIZE {world}")
    return Mesh(world=world, rank=rank, local_rank=local_rank,
                local_world=local_world, backend=dist.get_backend(),
                device=dev, group=dist.group.WORLD)


def node_mesh(mesh: Mesh) -> Mesh:
    """The ranks of this rank's node as a mesh of their own (a process
    group over them; every rank of the world calls this)."""
    if mesh.nodes == 1:
        return mesh
    group = None
    for node in range(mesh.nodes):
        ranks = list(range(node * mesh.local_world,
                           (node + 1) * mesh.local_world))
        g = dist.new_group(ranks, backend=mesh.backend)
        if node == mesh.node:
            group = g
    if mesh.local_world == 1:
        return dataclasses.replace(SINGLE, device=mesh.device)
    return dataclasses.replace(mesh, world=mesh.local_world,
                               rank=mesh.local_rank, group=group)


def process_shard(n: int, mesh: Mesh = SINGLE,
                  drop_remainder: bool = True) -> Tuple[int, int]:
    """This node's contiguous [start, stop) of a length-``n`` global batch
    axis (node-major)."""
    nodes, node = mesh.nodes, mesh.node
    if drop_remainder:
        per = n // nodes
        return node * per, (node + 1) * per
    starts = np.linspace(0, n, nodes + 1).astype(int)
    return int(starts[node]), int(starts[node + 1])


def expert_assignment(num_experts: int, mesh: Mesh = SINGLE) -> Sequence[int]:
    """The experts this node trains in the fan-out: round-robin over
    nodes, so each node writes its buffers under the experts' global
    indices with no traffic between nodes."""
    return list(range(mesh.node, num_experts, max(1, mesh.nodes)))


def data_axis_size(mesh: Mesh = SINGLE) -> int:
    return mesh.data


def pad_to_multiple(n: int, k: int) -> int:
    """Smallest multiple of ``k`` >= ``n``."""
    return ((n + k - 1) // k) * k


@dataclasses.dataclass(frozen=True)
class RowShard:
    """A generator for a rank's rows of a batch: the draws of the whole
    batch of ``total`` rows come from ``generator``, and this rank keeps
    rows [``start``, ``start`` + its count).  Passed where a tower takes
    its ``generator``, so that a dropout mask, a drop-path mask or an
    augment plan under data parallelism is the one-rank run's.  Rows at
    or past ``total`` (pad-and-mask slots) draw ``fill``."""

    generator: torch.Generator
    start: int
    total: int

    @property
    def device(self) -> torch.device:
        return self.generator.device


def rows_of(draw: Callable[..., torch.Tensor], shape: Sequence[int],
            generator, device, fill: float = 0.0) -> torch.Tensor:
    """``draw(shape, generator=, device=)`` for a batch-first ``shape``;
    through a :class:`RowShard`, the whole batch's draw cut to this rank's
    rows."""
    if not isinstance(generator, RowShard):
        return draw(tuple(shape), generator=generator, device=device)
    n, rest = int(shape[0]), tuple(shape[1:])
    full = draw((generator.total,) + rest, generator=generator.generator,
                device=device)
    mine = full[generator.start:generator.start + n]
    if mine.shape[0] < n:
        mine = torch.cat([mine, torch.full((n - mine.shape[0],) + rest, fill,
                                           dtype=mine.dtype, device=device)])
    return mine

