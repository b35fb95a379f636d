"""Multi-rank execution: the grid split along x over torch.distributed.

Counterpart: ksfd_tpu/parallel (the same export list,
ksfd_tpu/parallel/__init__.py:17-29); the slab mesh, its halo rows and
its reductions are in mesh.py.
"""

from .mesh import (
    grid_mesh,
    state_sharding,
    distribute,
    mesh_shape_for,
)
from .distributed import (
    maybe_init_distributed,
    process_count,
    process_index,
    owned_box,
    local_values,
    global_from_local,
    process_box,
)

__all__ = [
    "grid_mesh",
    "state_sharding",
    "distribute",
    "mesh_shape_for",
    "maybe_init_distributed",
    "process_count",
    "process_index",
    "owned_box",
    "local_values",
    "global_from_local",
    "process_box",
]
