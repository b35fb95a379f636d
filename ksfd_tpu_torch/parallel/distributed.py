"""Multi-process execution: one rank per box of the grid.

Counterpart: ksfd_tpu/parallel/distributed.py.  The reference starts
one JAX process per host from ``KSFD_COORDINATOR``, ``KSFD_NUM_PROCS``
and ``KSFD_PROC_ID`` and joins every device into one global mesh.  The
port starts one torch.distributed rank per box (an x-slab, or a
block of an x, y[, z] split) from the same
variables (the mpiexec analog):

    KSFD_COORDINATOR=localhost:29500 KSFD_NUM_PROCS=2 KSFD_PROC_ID=$i \\
        python my_run.py

where ``my_run.py`` calls ``maybe_init_distributed()`` before it builds
its mesh (parallel/mesh.py ``grid_mesh``).  The backend is NCCL on the
card and gloo on the CPU unless the caller names one.

State crosses between the global array and the ranks' slabs through
``distribute`` (parallel/mesh.py: a global numpy state becomes this
rank's slab) and ``global_from_local`` / ``local_values`` (this rank's
block, as numpy or as the slab tensor); ``SlabMesh.gather`` assembles
the global state again on every rank.  ``owned_box`` and
``process_box`` give the block's spatial ranges, as the reference's do
for the slab files its I/O writes: the driver (ksfdsolver.py main)
runs the Solver on the rank's slab, and each rank writes and resumes
its own ``<save>s<N>r<k>.h5`` with that box in ``/ranges``.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from ..utils.exceptions import KSFDException

__all__ = [
    "maybe_init_distributed",
    "process_count",
    "process_index",
    "owned_box",
    "local_values",
    "global_from_local",
    "process_box",
]


def maybe_init_distributed(coordinator=None, num_processes=None,
                           process_id=None, backend=None, device=None):
    """Initialize torch.distributed from the arguments or the ``KSFD_*``
    environment variables; returns True when it did.

    coordinator: ``host:port`` of rank 0's store (``KSFD_COORDINATOR``);
    num_processes (``KSFD_NUM_PROCS``) and process_id
    (``KSFD_PROC_ID``).  A no-op returning False when any is missing.
    backend: ``nccl`` when ``device`` (the card unless given) is a CUDA
    device, else ``gloo``.  With NCCL each rank takes the card
    ``process_id % device_count``.  A no-op returning False as well
    when a process group already exists: a caller that made its own
    group (two gloo ranks sharing one card, which NCCL cannot pair)
    then runs the driver over it.  Counterpart:
    ksfd_tpu/parallel/distributed.py:maybe_init_distributed.
    """
    if dist.is_available() and dist.is_initialized():
        return False
    coordinator = coordinator or os.environ.get("KSFD_COORDINATOR")
    if num_processes is None and "KSFD_NUM_PROCS" in os.environ:
        num_processes = int(os.environ["KSFD_NUM_PROCS"])
    if process_id is None and "KSFD_PROC_ID" in os.environ:
        process_id = int(os.environ["KSFD_PROC_ID"])
    if not coordinator or num_processes is None or process_id is None:
        return False
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method="tcp://" + coordinator,
        world_size=int(num_processes), rank=int(process_id),
    )
    return True


def process_count():
    """The number of ranks (1 without torch.distributed).  Counterpart:
    ksfd_tpu/parallel/distributed.py:process_count."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index():
    """This rank (0 without torch.distributed).  Counterpart:
    ksfd_tpu/parallel/distributed.py:process_index."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_box(grid, mesh):
    """The spatial block ``((lo, hi), ...)`` of the global state that
    this rank holds, split in any axis (parallel/mesh.py SlabMesh.box).
    Counterpart: ksfd_tpu/parallel/distributed.py:process_box."""
    if tuple(int(n) for n in grid.nps) != mesh.nps:
        raise KSFDException("the mesh splits a %s grid, not %s"
                            % (mesh.nps, tuple(int(n) for n in grid.nps)))
    return mesh.box


def owned_box(u_loc, mesh):
    """``process_box`` of a rank's slab, checked against its shape.
    Counterpart: ksfd_tpu/parallel/distributed.py:owned_box."""
    box = process_box(mesh.grid, mesh)
    shape = tuple(hi - lo for lo, hi in box)
    if tuple(u_loc.shape[1:]) != shape:
        raise KSFDException(
            "slab shape %s is not this rank's block %s"
            % (tuple(u_loc.shape[1:]), shape))
    return box


def local_values(u, mesh, box=None):
    """This rank's block as numpy, from its slab or from a global array
    (only the block is copied to the host).  Counterpart:
    ksfd_tpu/parallel/distributed.py:local_values."""
    box = box or process_box(mesh.grid, mesh)
    full = tuple(u.shape[1:]) == tuple(int(n) for n in mesh.grid.nps)
    if full:
        u = u[(slice(None),) + tuple(slice(lo, hi) for lo, hi in box)]
    elif tuple(u.shape[1:]) != tuple(hi - lo for lo, hi in box):
        raise KSFDException("array shape %s is neither the global state "
                            "nor this rank's block" % (tuple(u.shape),))
    if isinstance(u, torch.Tensor):
        return u.detach().cpu().numpy()
    return np.array(u)


def global_from_local(local, grid, mesh, box=None):
    """This rank's slab tensor on the mesh's device from its block
    (numpy or tensor), or from the full global array when every rank
    holds it (identical deterministic initial conditions).  Counterpart:
    ksfd_tpu/parallel/distributed.py:global_from_local."""
    local = torch.as_tensor(np.asarray(local) if not isinstance(
        local, torch.Tensor) else local)
    return torch.as_tensor(
        local_values(local, mesh, box=box)).to(mesh.device)
