"""Data parallelism across cards and processes (:mod:`.mesh`,
:mod:`.collectives`)."""

from .mesh import (  # noqa: F401
    SINGLE,
    Mesh,
    RowShard,
    expert_assignment,
    get_mesh,
    node_mesh,
)
